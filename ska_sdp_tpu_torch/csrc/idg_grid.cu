// Streamed IDG(-AW) gridder for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ska_sdp_tpu/kernels/idg_aw_stream_pallas.py::_kernel
// (launched by idg_aw_grid_from_records_stream).  Same operator: records are
// sorted into runs sharing one antenna pair and one uv tile; per run r with
// records b in [starts[r], ends[r]) and subgrid size S,
//
//   ph_y[q,b] = 2π/S·c_q·dy_b − π·(c_q·θ/S)²·w_b        c_q = q − S/2
//   ph_x[r,b] = 2π/S·c_r·dx_b − π·(c_r·θ_x/S)²·w_b
//   a[q,r]    = Σ_b (v_b·e^{i·ph_y[q,b]})·e^{i·ph_x[r,b]}
//   t         = a ∘ conj(A[ia1]·A[ia2])                  (pair screen)
//   patch     = F·t·Fᵀ      F[y,q] = e^{−2πi(y−S/2)(q−S/2)/S}/S · taper[q]
//   grid[y0 + y, x0 + x] += patch[y, x]
//
// into a complex64 padded grid [N + 2S, Nx + 2S]; the wrapper crops it.
//
// It also stands for the run-major ska_sdp_tpu/kernels/idg_aw_pallas.py::_kernel
// (the same operator, one grid step per run, used by the reference's spectral
// cubes under SKA_SDP_TPU_IDG_AW_KERNEL=run): its double-buffered block DMA,
// lane-interleaved sandwich factors and aligned rolls are TPU plumbing
// (parity: tests/test_torch_spectral.py, chip_smoke.py phase 23).
//
// Design (a simple, correct first kernel):
// * one thread block of 256 threads per run; nothing is carried between
//   blocks (the TPU kernel's accumulator persists across sequential grid
//   steps instead);
// * the block stages 32 records at a time in shared memory, evaluates their
//   phase factors with full-precision sincosf (|ph| reaches ~110 rad, where
//   __sincosf loses accuracy; do not build with --use_fast_math), and each
//   thread accumulates an (S/16)×(S/16) tile of a[q,r] in registers with f32
//   FMAs (rows q = ty + 16i, columns r = tx + 16j: conflict-free reads);
// * the run epilogue applies the pair screen (ids clamped to nant − 1, as
//   the TPU kernel does), forms F·t·Fᵀ through one S×S shared buffer, and
//   atomicAdds the patch at (y0, x0).  Neighbouring runs' patches overlap,
//   so the sum order on the grid is not fixed from run to run.
//
// Bound on this card: about 4·S² f32 MACs per visibility for the
// accumulation plus about 8·S³ per run for the sandwich, all on the CUDA
// cores (67 TFLOP/s f32 peak on an H100 SXM).  Plan: move both products to
// the tensor cores (split-bf16 or TF32 with error compensation) and balance
// the long runs of track data across blocks, in later work.
//
// C interface for ctypes: idg_grid_stream() launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 × 16 thread tile
constexpr int kChunk = 32;      // records staged per pass
constexpr int kRows = 5;        // dy, dx, w, vis_re, vis_im

template <int S>
constexpr size_t smem_bytes() {
  // accumulation: u[kChunk][S] + ex[kChunk][S] (float2) + records;
  // epilogue: one S×S float2 buffer.  The two phases share the space.
  size_t acc = 2 * size_t(kChunk) * S * sizeof(float2)
               + size_t(kRows) * kChunk * sizeof(float);
  size_t fin = size_t(S) * S * sizeof(float2);
  return acc > fin ? acc : fin;
}

__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

template <int S>
__global__ void __launch_bounds__(kThreads)
idg_grid_kernel(const float* __restrict__ recs, int64_t n_stride,
                const int* __restrict__ starts, const int* __restrict__ ends,
                const int* __restrict__ y0s, const int* __restrict__ x0s,
                const int* __restrict__ ia1s, const int* __restrict__ ia2s,
                const float2* __restrict__ scr, int nant,
                const float2* __restrict__ F, const float2* __restrict__ FT,
                float2* __restrict__ grid, int WP,
                float two_pi_s, float theta_s, float theta_x_s) {
  constexpr int T = S / 16;
  const int run = blockIdx.x;
  const int start = starts[run];
  const int end = ends[run];
  if (end <= start) return;

  extern __shared__ float4 smem_raw[];
  float2* smem = reinterpret_cast<float2*>(smem_raw);
  float2* u_s = smem;                       // [kChunk][S]  v·e_y
  float2* ex_s = smem + kChunk * S;         // [kChunk][S]  e_x
  float* rec_s = reinterpret_cast<float*>(smem + 2 * kChunk * S);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float pi_f = 3.14159265358979323846f;

  float2 acc[T][T];
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < T; ++j) acc[i][j] = make_float2(0.f, 0.f);

  for (int c0 = start; c0 < end; c0 += kChunk) {
    const int nb = min(kChunk, end - c0);
    __syncthreads();                        // previous chunk consumed
    if (tid < kRows * kChunk) {
      const int k = tid / kChunk;
      const int b = tid % kChunk;
      rec_s[tid] = b < nb ? recs[k * n_stride + c0 + b] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < nb * S; e += kThreads) {
      const int b = e / S;
      const int q = e - b * S;
      const float cq = float(q - S / 2);
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
      u_s[b * S + q] = make_float2(cy * vr - sy * vi, cy * vi + sy * vr);
      ex_s[b * S + q] = make_float2(cx, sx);
    }
    __syncthreads();
    for (int b = 0; b < nb; ++b) {
      float2 uq[T], er[T];
#pragma unroll
      for (int i = 0; i < T; ++i) uq[i] = u_s[b * S + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < T; ++j) er[j] = ex_s[b * S + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int j = 0; j < T; ++j) cmac(acc[i][j], uq[i], er[j]);
    }
  }

  // ---- run epilogue: pair screen, DFT sandwich, placement --------------
  __syncthreads();                          // accumulation buffers free
  float2* tb = smem;                        // [S][S]
  const int i1 = max(0, min(ia1s[run], nant - 1));
  const int i2 = max(0, min(ia2s[run], nant - 1));
  const float2* A1 = scr + size_t(i1) * S * S;
  const float2* A2 = scr + size_t(i2) * S * S;
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const int idx = (ty + 16 * i) * S + tx + 16 * j;
      const float2 a1 = A1[idx];
      const float2 a2 = A2[idx];
      // conj(a1·a2)
      const float2 pc = make_float2(a1.x * a2.x - a1.y * a2.y,
                                    -(a1.x * a2.y + a1.y * a2.x));
      const float2 a = acc[i][j];
      tb[idx] = make_float2(a.x * pc.x - a.y * pc.y, a.x * pc.y + a.y * pc.x);
      acc[i][j] = make_float2(0.f, 0.f);
    }
  __syncthreads();
  // B = F·t : thread owns rows y = ty + 16i, columns r = tx + 16j
  for (int q = 0; q < S; ++q) {
    float2 fy[T], tr[T];
#pragma unroll
    for (int i = 0; i < T; ++i) fy[i] = F[(ty + 16 * i) * S + q];
#pragma unroll
    for (int j = 0; j < T; ++j) tr[j] = tb[q * S + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int j = 0; j < T; ++j) cmac(acc[i][j], fy[i], tr[j]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < T; ++j) {
      tb[(ty + 16 * i) * S + tx + 16 * j] = acc[i][j];
      acc[i][j] = make_float2(0.f, 0.f);
    }
  __syncthreads();
  // patch = B·Fᵀ : thread owns rows y = ty + 16i, columns x = tx + 16j
  for (int r = 0; r < S; ++r) {
    float2 br[T], fx[T];
#pragma unroll
    for (int i = 0; i < T; ++i) br[i] = tb[(ty + 16 * i) * S + r];
#pragma unroll
    for (int j = 0; j < T; ++j) fx[j] = FT[r * S + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int j = 0; j < T; ++j) cmac(acc[i][j], br[i], fx[j]);
  }
  const int y0 = y0s[run];
  const int x0 = x0s[run];
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < T; ++j) {
      float2* g = grid + size_t(y0 + ty + 16 * i) * WP + x0 + tx + 16 * j;
      atomicAdd(&g->x, acc[i][j].x);
      atomicAdd(&g->y, acc[i][j].y);
    }
}

template <int S>
cudaError_t launch(const float* recs, int64_t n_stride, const int* starts,
                   const int* ends, const int* y0, const int* x0,
                   const int* ia1, const int* ia2, int n_runs,
                   const float2* scr, int nant, const float2* F,
                   const float2* FT, float2* grid, int WP, float two_pi_s,
                   float theta_s, float theta_x_s, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<S>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        idg_grid_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
  }
  idg_grid_kernel<S><<<n_runs, kThreads, smem, stream>>>(
      recs, n_stride, starts, ends, y0, x0, ia1, ia2, scr, nant, F, FT, grid,
      WP, two_pi_s, theta_s, theta_x_s);
  return cudaGetLastError();
}

}  // namespace

extern "C" int idg_grid_stream(const void* recs, long long n_stride,
                               const void* starts, const void* ends,
                               const void* y0, const void* x0,
                               const void* ia1, const void* ia2, int n_runs,
                               const void* screens, int nant, const void* F,
                               const void* FT, void* grid, int WP, int S,
                               float two_pi_s, float theta_s,
                               float theta_x_s, void* stream) {
  if (n_runs <= 0) return int(cudaGetLastError());
  auto r = static_cast<const float*>(recs);
  auto st = static_cast<const int*>(starts);
  auto en = static_cast<const int*>(ends);
  auto yy = static_cast<const int*>(y0);
  auto xx = static_cast<const int*>(x0);
  auto a1 = static_cast<const int*>(ia1);
  auto a2 = static_cast<const int*>(ia2);
  auto sc = static_cast<const float2*>(screens);
  auto f = static_cast<const float2*>(F);
  auto ft = static_cast<const float2*>(FT);
  auto g = static_cast<float2*>(grid);
  auto s = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 32:
      return int(launch<32>(r, n_stride, st, en, yy, xx, a1, a2, n_runs, sc,
                            nant, f, ft, g, WP, two_pi_s, theta_s, theta_x_s,
                            s));
    case 64:
      return int(launch<64>(r, n_stride, st, en, yy, xx, a1, a2, n_runs, sc,
                            nant, f, ft, g, WP, two_pi_s, theta_s, theta_x_s,
                            s));
    case 128:
      return int(launch<128>(r, n_stride, st, en, yy, xx, a1, a2, n_runs, sc,
                             nant, f, ft, g, WP, two_pi_s, theta_s,
                             theta_x_s, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* idg_grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
