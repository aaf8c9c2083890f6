// Fixed-tile IDG degridder for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ska_sdp_tpu/kernels/idg_degrid_pallas.py::_kernel
// (launched by idg_degrid_wproj_pallas).  Same operator, the adjoint of
// idg_tile_grid.cu: records are sorted by subgrid id; the wrapper has formed
// each occupied subgrid's image a = Fᴴ·W·conj(F) from its window W of the
// padded model grid (F as in the gridder, taper and 1/S included: a batched
// matmul outside the kernel, as the TPU kernel leaves it to XLA).  Block b
// serves subgrid t = occ[b] with records [starts[t], starts[t + 1]):
//
//   ph_y[q,i] = 2π/S·c_q·dy_i − π·(c_q·θ/S)²·w_i        c_q = q − S/2
//   ph_x[r,i] = 2π/S·c_r·dx_i − π·(c_r·θ_x/S)²·w_i
//   v_i       = Σ_q e^{−i·ph_y[q,i]} · Σ_r a[q,r]·e^{−i·ph_x[r,i]}
//
// written to out[order[i]].
//
// Design (a simple, correct first kernel):
// * one thread block of 256 threads per occupied subgrid, with the subgrid's
//   image in shared memory, padded to SP = 16·TM (TM = ⌈S/16⌉, one template
//   instance per TM) with zeros in rows and columns q ≥ S;
// * records are taken 32 at a time, one per lane: their conjugated phase
//   factors (full-precision sincosf: |ph| reaches ~35 rad at S=32 on a 2400²
//   grid, where __sincosf loses accuracy; do not build with --use_fast_math)
//   go to shared memory, each of the 8 warps contracts SP/8 rows of a
//   against them (the (SP×SP)·(SP×32) product), weights its rows by
//   conj(e_y), and the warps' partial sums are added in shared memory;
// * each record is written exactly once, straight to its original index, so
//   the output needs no atomics and no unsort pass (the TPU kernel's
//   head/main block protocol and the sort that undoes the binning are DMA
//   artifacts with no counterpart here), and it is the same from run to run.
//   Records whose anchor lies off the grid belong to no subgrid and keep the
//   wrapper's zero.
//
// Shared memory: SP²·8 bytes for a plus 2·SP·32·8 for the phase factors —
// 194 KiB at S=128, under the 227 KiB opt-in limit (cudaFuncSetAttribute).
//
// Bound on this card: 8·S² f32 flop per visibility on the CUDA cores
// (67 TFLOP/s f32 peak on an H100 SXM); the contraction reads one broadcast
// shared value per two complex MACs.  Plan: tensor cores (split-bf16 or TF32
// with error compensation), in later work.
//
// C interface for ctypes: idg_tile_degrid() launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;               // records per pass, one per lane
constexpr int kRows = 3;                 // dy, dx, w

template <int TM>
constexpr size_t smem_bytes() {
  constexpr int SP = 16 * TM;
  return size_t(SP) * SP * sizeof(float2)              // a
         + 2 * size_t(SP) * kChunk * sizeof(float2)    // conj(e_y), conj(e_x)
         + size_t(kWarps) * kChunk * sizeof(float2)    // per-warp sums
         + size_t(kRows) * kChunk * sizeof(float);     // staged records
}

// acc += a·b
__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
idg_tile_degrid_kernel(const float* __restrict__ recs, int64_t n_stride,
                       const int* __restrict__ starts,
                       const int* __restrict__ occ,
                       const float2* __restrict__ a_sub,
                       const int* __restrict__ order, int S,
                       float two_pi_s, float theta_s, float theta_x_s,
                       float2* __restrict__ out) {
  constexpr int SP = 16 * TM;
  constexpr int Q = SP / kWarps;            // rows of a per warp
  const int sub = occ[blockIdx.x];
  const int start = starts[sub];
  const int end = starts[sub + 1];
  if (end <= start) return;

  extern __shared__ float4 smem_raw[];
  float2* tb = reinterpret_cast<float2*>(smem_raw);    // [SP][SP]
  float2* ey_s = tb + SP * SP;                          // [SP][kChunk]
  float2* ex_s = ey_s + SP * kChunk;                    // [SP][kChunk]
  float2* red_s = ex_s + SP * kChunk;                   // [kWarps][kChunk]
  float* rec_s = reinterpret_cast<float*>(red_s + kWarps * kChunk);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float pi_f = 3.14159265358979323846f;
  const int half = S / 2;

  const float2* a = a_sub + size_t(blockIdx.x) * S * S;
  for (int e = tid; e < SP * SP; e += kThreads) {
    const int q = e / SP;
    const int r = e - q * SP;
    tb[e] = (q < S && r < S) ? a[q * S + r] : make_float2(0.f, 0.f);
  }

  for (int c0 = start; c0 < end; c0 += kChunk) {
    const int nb = min(kChunk, end - c0);
    if (tid < kRows * kChunk) {
      const int k = tid / kChunk;
      const int b = tid % kChunk;
      rec_s[tid] = b < nb ? recs[k * n_stride + c0 + b] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < SP * kChunk; e += kThreads) {
      const int q = e / kChunk;
      const int b = e - q * kChunk;
      const float cq = float(q - half);
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
    // t[q, b] = Σ_r a[q, r]·conj(e_x[r, b]) for q = warp + 8i, b = lane
    float2 t[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) t[i] = make_float2(0.f, 0.f);
    for (int r = 0; r < SP; r += 2) {
      const float2 e0 = ex_s[r * kChunk + lane];
      const float2 e1 = ex_s[(r + 1) * kChunk + lane];
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(
            &tb[(warp + kWarps * i) * SP + r]);
        cmac(t[i], make_float2(av.x, av.y), e0);
        cmac(t[i], make_float2(av.z, av.w), e1);
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

template <int TM>
cudaError_t launch(const float* recs, int64_t n_stride, const int* starts,
                   const int* occ, int n_occ, const float2* a_sub,
                   const int* order, int S, float two_pi_s, float theta_s,
                   float theta_x_s, float2* out, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<TM>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        idg_tile_degrid_kernel<TM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  idg_tile_degrid_kernel<TM><<<n_occ, kThreads, smem, stream>>>(
      recs, n_stride, starts, occ, a_sub, order, S, two_pi_s, theta_s,
      theta_x_s, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int idg_tile_degrid(const void* recs, long long n_stride,
                               const void* starts, const void* occ,
                               int n_occ, const void* a_sub,
                               const void* order, int S, float two_pi_s,
                               float theta_s, float theta_x_s, void* out,
                               void* stream) {
  if (n_occ <= 0) return int(cudaGetLastError());
  if (S < 2 || S > 128 || S % 2) return int(cudaErrorInvalidValue);
  auto r = static_cast<const float*>(recs);
  auto st = static_cast<const int*>(starts);
  auto oc = static_cast<const int*>(occ);
  auto a = static_cast<const float2*>(a_sub);
  auto od = static_cast<const int*>(order);
  auto o = static_cast<float2*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define IDG_TILE_DEGRID_CASE(TM)                                          \
  case TM:                                                                \
    return int(launch<TM>(r, n_stride, st, oc, n_occ, a, od, S, two_pi_s, \
                          theta_s, theta_x_s, o, s));
  switch ((S + 15) / 16) {
    IDG_TILE_DEGRID_CASE(1)
    IDG_TILE_DEGRID_CASE(2)
    IDG_TILE_DEGRID_CASE(3)
    IDG_TILE_DEGRID_CASE(4)
    IDG_TILE_DEGRID_CASE(5)
    IDG_TILE_DEGRID_CASE(6)
    IDG_TILE_DEGRID_CASE(7)
    IDG_TILE_DEGRID_CASE(8)
    default:
      return int(cudaErrorInvalidValue);
  }
#undef IDG_TILE_DEGRID_CASE
}

extern "C" const char* idg_tile_degrid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
