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
//   X* = conj(P[p] ⊙ Ŵ[k])                                  (m × m)
//   grid[y0 + i, x0 + j] += vis[b] · (S* · X* · S*ᵀ)[i, j]   0 ≤ i, j < s
//
// i.e. vis · conj(S · (P ⊙ Ŵ) · Sᵀ) with S = _synthesis_mat(s, m) (s × m,
// the m² scale split m per axis), for the cells inside [0, H) × [0, W).  A
// record with no cell inside adds nothing.  The tables are raw (not
// conjugated); the caller passes S* itself.
//
// Design (a simple, correct first kernel): one warp per record, grid-
// striding over the records in input order (no sort), several warps per
// block.
//   1. the warp forms X* in its own shared buffer (m rows of odd stride
//      m + 1, so that lanes walking down a column hit distinct banks),
//      reading both table rows with coalesced 16-byte loads;
//   2. R = X* · S*ᵀ (m × s): lane k owns row k, keeps its s sums in
//      registers and writes them back over its own row of X*; S*ᵀ sits in
//      shared memory as [m][s rounded up to even], read two entries at a
//      time as broadcasts;
//   3. Y = S* · R (s × s): lane (h, j) owns column j and rows h, h + NH, …;
//      S* sits in shared memory as [s][m];
//   4. vis · Y goes into the complex64 grid with float2 atomics (the vector
//      atomicAdd of compute capability 9.x where the toolkit offers it).
//      Atomics make the summation order vary from run to run.
// Where n_valid is not null, each warp adds the number of records it placed
// (those with some cell inside the grid) to it, once, at its end.
// Every sum is f32 on the CUDA cores: the reference's "exact" precision
// tier.  m = next_pow2(2s − 1) ∈ {1, 4, 8, 16, 32, 64}: supports 1 ≤ s ≤ 32.
//
// Bound on this card: 8·(m²·s + s²·m) + 6·m² + 6·s² f32 operations per
// valid record, ≈ 188 kflop at s = 15, m = 32; the bytes the function must
// move (records, visibilities, both tables once, the grid once) are small
// beside that, so it is bound by operations.  What limits this first
// version is the shared-memory traffic of steps 2 and 3 and the table rows
// each record reads from L2 or device memory (8 KB each at m = 32).
//
// C interface for ctypes: aw_grid() launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (or cudaErrorInvalidValue for
// a shape outside the envelope).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// acc += a · b (complex), four FMAs
__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

// conj(a · b)
__device__ __forceinline__ float2 conj_mul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, -(a.x * b.y + a.y * b.x));
}

template <int M>
struct Geo {
  static constexpr int SMAX = (M + 1) / 2;          // largest s for this m
  static constexpr int ACC = SMAX + (SMAX & 1);     // even
  static constexpr int JW = SMAX <= 16 ? 16 : 32;   // lanes across columns
  static constexpr int NH = 32 / JW;                // row phases
  static constexpr int RMAX = (SMAX + NH - 1) / NH; // rows per lane
  static constexpr int XS = M + 1;                  // odd row stride
  static constexpr int XN = (M * XS + 1) & ~1;      // buffer, even
  static constexpr int WARPS = M <= 32 ? 8 : 4;
};

__host__ __device__ constexpr int even(int x) { return (x + 1) & ~1; }

template <int M>
__host__ __device__ constexpr int smem_float2s(int s) {
  return even(s * M) + M * even(s) + Geo<M>::WARPS * Geo<M>::XN;
}

template <int M>
__global__ void __launch_bounds__(Geo<M>::WARPS * 32)
aw_grid_kernel(const float2* __restrict__ pair_tab, int npair,
               const float2* __restrict__ w_spec, int nk,
               const float2* __restrict__ sconj, int s,
               const int* __restrict__ recs, int64_t n,
               const float2* __restrict__ vis, float2* __restrict__ grid,
               int H, int W, int* __restrict__ n_valid) {
  using G = Geo<M>;
  extern __shared__ float4 smem[];
  float2* sc = reinterpret_cast<float2*>(smem);     // S*  [s][M]
  const int sp = even(s);
  float2* sct = sc + even(s * M);                   // S*ᵀ [M][sp]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float2* xs = sct + M * sp + warp * G::XN;         // this warp's X*, R

  for (int e = threadIdx.x; e < s * M; e += blockDim.x) sc[e] = sconj[e];
  for (int e = threadIdx.x; e < M * sp; e += blockDim.x) {
    const int l = e / sp, j = e - l * sp;
    sct[e] = j < s ? sconj[j * M + l] : make_float2(0.f, 0.f);
  }
  __syncthreads();

  const int jc = lane % G::JW;                      // step 3 column
  const int h = lane / G::JW;                       // step 3 row phase
  const int64_t nwarps = int64_t(gridDim.x) * G::WARPS;
  int placed = 0;
  for (int64_t b = int64_t(blockIdx.x) * G::WARPS + warp; b < n;
       b += nwarps) {
    const int y0 = recs[b];
    const int x0 = recs[n + b];
    if (y0 <= -s || y0 >= H || x0 <= -s || x0 >= W) continue;  // warp-wide
    ++placed;
    const int pid = min(max(recs[2 * n + b], 0), npair - 1);
    const int kid = min(max(recs[3 * n + b], 0), nk - 1);
    const float2 v = vis[b];
    const float2* prow = pair_tab + int64_t(pid) * (M * M);
    const float2* wrow = w_spec + int64_t(kid) * (M * M);

    // 1. X* = conj(P ⊙ Ŵ)
    if constexpr (M >= 4) {
      const float4* p4 = reinterpret_cast<const float4*>(prow);
      const float4* w4 = reinterpret_cast<const float4*>(wrow);
#pragma unroll 4
      for (int e = lane; e < M * M / 2; e += 32) {
        const float4 a = __ldg(p4 + e), c = __ldg(w4 + e);
        const int r = (2 * e) / M, col = 2 * e - r * M;
        float2* dst = xs + r * G::XS + col;
        dst[0] = conj_mul(make_float2(a.x, a.y), make_float2(c.x, c.y));
        dst[1] = conj_mul(make_float2(a.z, a.w), make_float2(c.z, c.w));
      }
    } else {
      if (lane == 0) xs[0] = conj_mul(__ldg(prow), __ldg(wrow));
    }
    __syncwarp();

    // 2. R = X* · S*ᵀ, row k over row k of X*
    for (int k = lane; k < M; k += 32) {
      float2 acc[G::ACC];
#pragma unroll
      for (int j = 0; j < G::ACC; ++j) acc[j] = make_float2(0.f, 0.f);
      float2* row = xs + k * G::XS;
#pragma unroll 2
      for (int l = 0; l < M; ++l) {
        const float2 x = row[l];
        const float4* st = reinterpret_cast<const float4*>(sct + l * sp);
#pragma unroll
        for (int j2 = 0; j2 < G::ACC / 2; ++j2) {
          if (2 * j2 < s) {
            const float4 q = st[j2];
            cmac(acc[2 * j2], x, make_float2(q.x, q.y));
            cmac(acc[2 * j2 + 1], x, make_float2(q.z, q.w));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < G::ACC; ++j)
        if (j < s) row[j] = acc[j];
    }
    __syncwarp();

    // 3. Y = S* · R, 4. grid += vis · Y
    if (jc < s) {
      float2 acc[G::RMAX];
#pragma unroll
      for (int r = 0; r < G::RMAX; ++r) acc[r] = make_float2(0.f, 0.f);
      if constexpr (M >= 4) {
#pragma unroll 2
        for (int k = 0; k < M; k += 2) {
          const float2 r0 = xs[k * G::XS + jc];
          const float2 r1 = xs[(k + 1) * G::XS + jc];
#pragma unroll
          for (int r = 0; r < G::RMAX; ++r) {
            const int i = h + G::NH * r;
            if (i < s) {
              const float4 q = *reinterpret_cast<const float4*>(sc + i * M + k);
              cmac(acc[r], make_float2(q.x, q.y), r0);
              cmac(acc[r], make_float2(q.z, q.w), r1);
            }
          }
        }
      } else {
        if (h < s) cmac(acc[0], sc[0], xs[0]);
      }
      const int x = x0 + jc;
      if (x >= 0 && x < W) {
#pragma unroll
        for (int r = 0; r < G::RMAX; ++r) {
          const int i = h + G::NH * r;
          const int y = y0 + i;
          if (i < s && y >= 0 && y < H) {
            const float2 a = acc[r];
            atomic_add_c(grid + int64_t(y) * W + x,
                         make_float2(fmaf(v.x, a.x, -v.y * a.y),
                                     fmaf(v.x, a.y, v.y * a.x)));
          }
        }
      }
    }
    __syncwarp();  // the next record overwrites the buffer
  }
  if (n_valid != nullptr && lane == 0 && placed > 0)
    atomicAdd(n_valid, placed);
}

template <int M>
int launch(const void* pair_tab, int npair, const void* w_spec, int nk,
           const void* sconj, int s, const void* recs, long long n,
           const void* vis, void* grid, int H, int W, void* n_valid,
           cudaStream_t stream) {
  using G = Geo<M>;
  if (s < 1 || s > G::SMAX) return int(cudaErrorInvalidValue);
  const size_t smem = size_t(smem_float2s<M>(s)) * sizeof(float2);
  cudaError_t rc = cudaFuncSetAttribute(
      aw_grid_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (rc != cudaSuccess) return int(rc);
  int dev = 0, sms = 0, per_sm = 0;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return int(rc);
  if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev)) != cudaSuccess)
    return int(rc);
  if ((rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, aw_grid_kernel<M>, G::WARPS * 32, smem)) != cudaSuccess)
    return int(rc);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  const long long want = (n + G::WARPS - 1) / G::WARPS;
  const long long cap = (long long)sms * per_sm;
  const int blocks = int(want < cap ? want : cap);
  aw_grid_kernel<M><<<blocks, G::WARPS * 32, smem, stream>>>(
      static_cast<const float2*>(pair_tab), npair,
      static_cast<const float2*>(w_spec), nk,
      static_cast<const float2*>(sconj), s, static_cast<const int*>(recs), n,
      static_cast<const float2*>(vis), static_cast<float2*>(grid), H, W,
      static_cast<int*>(n_valid));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int aw_grid(const void* pair_tab, int npair, const void* w_spec,
                       int nk, const void* sconj, int s, int m,
                       const void* recs, long long n, const void* vis,
                       void* grid, int H, int W, void* n_valid,
                       void* stream) {
  if (n <= 0) return int(cudaGetLastError());
  if (npair < 1 || nk < 1) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return launch<1>(pair_tab, npair, w_spec, nk, sconj, s, recs, n,
                             vis, grid, H, W, n_valid, st);
    case 4: return launch<4>(pair_tab, npair, w_spec, nk, sconj, s, recs, n,
                             vis, grid, H, W, n_valid, st);
    case 8: return launch<8>(pair_tab, npair, w_spec, nk, sconj, s, recs, n,
                             vis, grid, H, W, n_valid, st);
    case 16: return launch<16>(pair_tab, npair, w_spec, nk, sconj, s, recs,
                               n, vis, grid, H, W, n_valid, st);
    case 32: return launch<32>(pair_tab, npair, w_spec, nk, sconj, s, recs,
                               n, vis, grid, H, W, n_valid, st);
    case 64: return launch<64>(pair_tab, npair, w_spec, nk, sconj, s, recs,
                               n, vis, grid, H, W, n_valid, st);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* aw_grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
