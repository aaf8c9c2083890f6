// Streamed IDG(-AW) degridder for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
// ska_sdp_tpu/kernels/idg_aw_stream_pallas.py::_degrid_kernel (launched by
// idg_aw_degrid_stream).  Same operator, the exact adjoint of idg_grid.cu:
// records are sorted into runs sharing one antenna pair and one uv tile; per
// run r with origin (y0, x0) in the padded complex64 grid [N + 2S, Nx + 2S]
// (the model grid sits at offset S) and subgrid size S,
//
//   W         = grid[y0 : y0 + S, x0 : x0 + S]
//   T         = Fᴴ·W·conj(F)    F[y,q] = e^{−2πi(y−S/2)(q−S/2)/S}/S · taper[q]
//   I         = T ∘ (A[ia1]·A[ia2])                     (pair screen, unconjugated)
//   ph_y[q,b] = 2π/S·c_q·dy_b − π·(c_q·θ/S)²·w_b        c_q = q − S/2
//   ph_x[r,b] = 2π/S·c_r·dx_b − π·(c_r·θ_x/S)²·w_b
//   v_b       = Σ_q e^{−i·ph_y[q,b]} · Σ_r I[q,r]·e^{−i·ph_x[r,b]}
//
// for each record b in [starts[r], ends[r]), written to out[order_s[b]].
//
// It also stands for the run-major
// ska_sdp_tpu/kernels/idg_aw_degrid_pallas.py::_kernel (the same operator;
// its head/main block protocol and unsort epilogue exist for the TPU's block
// DMA: here each visibility is written once to its original index; parity:
// tests/test_torch_spectral.py).
//
// Design (a simple, correct first kernel):
// * one thread block of 256 threads per run, as in the gridder; the TPU
//   kernel walks one sorted stream on one core and carries the run image in
//   scratch from block to block instead;
// * the prologue stages W in one S×S shared buffer and forms T through the
//   same buffer (Fᴴ·W, then ·conj(F)), each thread holding an (S/16)×(S/16)
//   register tile; the pair screen is applied on the way back, so the buffer
//   ends holding I;
// * records are taken 32 at a time, one per lane: their conjugated phase
//   factors (full-precision sincosf: |ph| reaches ~110 rad, where __sincosf
//   loses accuracy; do not build with --use_fast_math) go to shared memory,
//   each warp contracts S/8 rows of I against them (the (S×S)·(S×32)
//   product), weights its rows by conj(e_y) and the 8 warps' partial sums are
//   added in shared memory;
// * each record is written exactly once, straight to its original index, so
//   the output needs no atomics or unsort pass and is the same from run to
//   run.  Sentinel runs (out-of-bounds and unfit records, pair id 2¹⁵) are
//   skipped and records past the run table belong to no run: the wrapper's
//   zero-filled output keeps all of them at exactly 0, as the reference's
//   `use` mask does.
//
// Shared memory: S²·8 bytes for I plus 2·S·32·8 for the phase factors — 195
// KiB at S=128, under the 227 KiB opt-in limit (cudaFuncSetAttribute).
//
// Bound on this card: about 4·S² f32 FMAs per visibility for the contraction
// plus 2·4·S³ per run for the sandwich, on the CUDA cores (67 TFLOP/s f32
// peak on an H100 SXM); the contraction reads one broadcast shared value per
// two complex MACs.  Plan: tensor cores (split-bf16 or TF32 with error
// compensation) and balancing long runs across blocks, in later work.
//
// C interface for ctypes: idg_degrid_stream() launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // 16 × 16 tile in the prologue
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;               // records per pass, one per lane
constexpr int kRows = 3;                 // dy, dx, w
constexpr int kPairShift = 1 << 15;      // sentinel runs decode ia1 = 2¹⁵

template <int S>
constexpr size_t smem_bytes() {
  return size_t(S) * S * sizeof(float2)              // W, then T, then I
         + 2 * size_t(S) * kChunk * sizeof(float2)   // conj(e_y), conj(e_x)
         + size_t(kWarps) * kChunk * sizeof(float2)  // per-warp partial sums
         + size_t(kRows) * kChunk * sizeof(float);   // staged records
}

// acc += a·b
__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

// acc += conj(a)·b
__device__ __forceinline__ void cmac_ca(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(-a.y, b.x, acc.y);
}

// acc += a·conj(b)
__device__ __forceinline__ void cmac_cb(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(a.y, b.y, acc.x);
  acc.y = fmaf(a.y, b.x, acc.y);
  acc.y = fmaf(-a.x, b.y, acc.y);
}

template <int S>
__global__ void __launch_bounds__(kThreads)
idg_degrid_kernel(const float* __restrict__ recs, int64_t n_stride,
                  const int* __restrict__ starts, const int* __restrict__ ends,
                  const int* __restrict__ y0s, const int* __restrict__ x0s,
                  const int* __restrict__ ia1s, const int* __restrict__ ia2s,
                  const int* __restrict__ order,
                  const float2* __restrict__ scr, int nant,
                  const float2* __restrict__ F,
                  const float2* __restrict__ grid, int WP,
                  float two_pi_s, float theta_s, float theta_x_s,
                  float2* __restrict__ out) {
  constexpr int T = S / 16;
  constexpr int Q = S / kWarps;             // rows of I per warp
  const int run = blockIdx.x;
  const int start = starts[run];
  const int end = ends[run];
  if (end <= start || ia1s[run] >= kPairShift) return;

  extern __shared__ float4 smem_raw[];
  float2* tb = reinterpret_cast<float2*>(smem_raw);    // [S][S]
  float2* ey_s = tb + S * S;                            // [S][kChunk]
  float2* ex_s = ey_s + S * kChunk;                     // [S][kChunk]
  float2* red_s = ex_s + S * kChunk;                    // [kWarps][kChunk]
  float* rec_s = reinterpret_cast<float*>(red_s + kWarps * kChunk);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  // ---- run prologue: window, adjoint sandwich, pair screen --------------
  const float2* win = grid + size_t(y0s[run]) * WP + x0s[run];
  for (int e = tid; e < S * S; e += kThreads) {
    const int y = e / S;
    tb[e] = win[size_t(y) * WP + (e - y * S)];
  }
  __syncthreads();

  float2 acc[T][T];
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < T; ++j) acc[i][j] = make_float2(0.f, 0.f);
  // B = Fᴴ·W : thread owns rows q = ty + 16i, columns x = tx + 16j
  for (int y = 0; y < S; ++y) {
    float2 fq[T], wx[T];
#pragma unroll
    for (int i = 0; i < T; ++i) fq[i] = F[y * S + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < T; ++j) wx[j] = tb[y * S + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int j = 0; j < T; ++j) cmac_ca(acc[i][j], fq[i], wx[j]);
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
  // T = B·conj(F) : thread owns rows q = ty + 16i, columns r = tx + 16j
  for (int x = 0; x < S; ++x) {
    float2 bq[T], fr[T];
#pragma unroll
    for (int i = 0; i < T; ++i) bq[i] = tb[(ty + 16 * i) * S + x];
#pragma unroll
    for (int j = 0; j < T; ++j) fr[j] = F[x * S + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int j = 0; j < T; ++j) cmac_cb(acc[i][j], bq[i], fr[j]);
  }
  __syncthreads();                          // every read of B is done
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
      const float2 pr = make_float2(a1.x * a2.x - a1.y * a2.y,
                                    a1.x * a2.y + a1.y * a2.x);
      const float2 t = acc[i][j];
      tb[idx] = make_float2(t.x * pr.x - t.y * pr.y, t.x * pr.y + t.y * pr.x);
    }
  __syncthreads();

  // ---- records: conjugate phase contraction, 32 at a time ---------------
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float pi_f = 3.14159265358979323846f;
  for (int c0 = start; c0 < end; c0 += kChunk) {
    const int nb = min(kChunk, end - c0);
    if (tid < kRows * kChunk) {
      const int k = tid / kChunk;
      const int b = tid % kChunk;
      rec_s[tid] = b < nb ? recs[k * n_stride + c0 + b] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < S * kChunk; e += kThreads) {
      const int q = e / kChunk;
      const int b = e - q * kChunk;
      const float cq = float(q - S / 2);
      const float ly = cq * theta_s;
      const float lx = cq * theta_x_s;
      const float w = rec_s[2 * kChunk + b];
      const float ph_y = two_pi_s * cq * rec_s[b] - pi_f * (ly * ly) * w;
      const float ph_x = two_pi_s * cq * rec_s[kChunk + b]
                         - pi_f * (lx * lx) * w;
      float sy, cy, sx, cx;
      sincosf(ph_y, &sy, &cy);
      sincosf(ph_x, &sx, &cx);
      ey_s[e] = make_float2(cy, -sy);
      ex_s[e] = make_float2(cx, -sx);
    }
    __syncthreads();
    // t[q, b] = Σ_r I[q, r]·conj(e_x[r, b]) for q = warp + 8i, b = lane
    float2 t[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) t[i] = make_float2(0.f, 0.f);
    for (int r = 0; r < S; r += 2) {
      const float2 e0 = ex_s[r * kChunk + lane];
      const float2 e1 = ex_s[(r + 1) * kChunk + lane];
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const float4 iv = *reinterpret_cast<const float4*>(
            &tb[(warp + kWarps * i) * S + r]);
        cmac(t[i], make_float2(iv.x, iv.y), e0);
        cmac(t[i], make_float2(iv.z, iv.w), e1);
      }
    }
    float2 part = make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < Q; ++i)
      cmac(part, ey_s[(warp + kWarps * i) * kChunk + lane], t[i]);
    red_s[warp * kChunk + lane] = part;
    __syncthreads();
    if (tid < nb) {
      float2 v = red_s[tid];
#pragma unroll
      for (int k = 1; k < kWarps; ++k) {
        const float2 p = red_s[k * kChunk + tid];
        v.x += p.x;
        v.y += p.y;
      }
      out[order[c0 + tid]] = v;
    }
  }
}

template <int S>
cudaError_t launch(const float* recs, int64_t n_stride, const int* starts,
                   const int* ends, const int* y0, const int* x0,
                   const int* ia1, const int* ia2, int n_runs,
                   const int* order, const float2* scr, int nant,
                   const float2* F, const float2* grid, int WP,
                   float two_pi_s, float theta_s, float theta_x_s,
                   float2* out, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<S>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        idg_degrid_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
  }
  idg_degrid_kernel<S><<<n_runs, kThreads, smem, stream>>>(
      recs, n_stride, starts, ends, y0, x0, ia1, ia2, order, scr, nant, F,
      grid, WP, two_pi_s, theta_s, theta_x_s, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int idg_degrid_stream(const void* recs, long long n_stride,
                                 const void* starts, const void* ends,
                                 const void* y0, const void* x0,
                                 const void* ia1, const void* ia2,
                                 int n_runs, const void* order,
                                 const void* screens, int nant,
                                 const void* F, const void* grid, int WP,
                                 int S, float two_pi_s, float theta_s,
                                 float theta_x_s, void* out, void* stream) {
  if (n_runs <= 0) return int(cudaGetLastError());
  auto r = static_cast<const float*>(recs);
  auto st = static_cast<const int*>(starts);
  auto en = static_cast<const int*>(ends);
  auto yy = static_cast<const int*>(y0);
  auto xx = static_cast<const int*>(x0);
  auto a1 = static_cast<const int*>(ia1);
  auto a2 = static_cast<const int*>(ia2);
  auto od = static_cast<const int*>(order);
  auto sc = static_cast<const float2*>(screens);
  auto f = static_cast<const float2*>(F);
  auto g = static_cast<const float2*>(grid);
  auto o = static_cast<float2*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 32:
      return int(launch<32>(r, n_stride, st, en, yy, xx, a1, a2, n_runs, od,
                            sc, nant, f, g, WP, two_pi_s, theta_s, theta_x_s,
                            o, s));
    case 64:
      return int(launch<64>(r, n_stride, st, en, yy, xx, a1, a2, n_runs, od,
                            sc, nant, f, g, WP, two_pi_s, theta_s, theta_x_s,
                            o, s));
    case 128:
      return int(launch<128>(r, n_stride, st, en, yy, xx, a1, a2, n_runs, od,
                             sc, nant, f, g, WP, two_pi_s, theta_s,
                             theta_x_s, o, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* idg_degrid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
