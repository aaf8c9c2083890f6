// Streamed IDG(-AW) gridder for NVIDIA Hopper (sm_90a), on the tensor cores.
//
// Replaces three TPU kernels of ska_sdp_tpu/kernels/ (one operator):
//   #1 idg_aw_stream_pallas.py::_kernel (idg_aw_grid_from_records_stream);
//   #3 idg_aw_stream_pallas.py::idg_aw_grid_banded, whose bands exist to fit
//      the grid into VMEM: here one padded HBM grid takes every run;
//   #5 idg_aw_pallas.py::_kernel, the run-major variant (one grid step per
//      run, used by the reference's spectral cubes under
//      SKA_SDP_TPU_IDG_AW_KERNEL=run): its double-buffered block DMA,
//      lane-interleaved sandwich factors and aligned rolls are TPU plumbing
//      (parity: tests/test_torch_spectral.py, chip_smoke.py phase 23).
// Records are sorted into runs sharing one antenna pair and one uv tile; per
// run r with records b in [starts[r], ends[r]) and subgrid size S,
//
//   ph_y[q,b] = 2π/S·c_q·dy_b − π·(c_q·θ/S)²·w_b        c_q = q − S/2
//   ph_x[r,b] = 2π/S·c_r·dx_b − π·(c_r·θ_x/S)²·w_b
//   a[q,r]    = Σ_b u[q,b]·e_x[r,b],  u = v_b·e^{i·ph_y},  e_x = e^{i·ph_x}
//   t         = a ∘ conj(A[ia1]·A[ia2])                  (pair screen)
//   patch     = F·t·Fᵀ      F[y,q] = e^{−2πi(y−S/2)(q−S/2)/S}/S · taper[q]
//   grid[y0 + y, x0 + x] += patch[y, x]
//
// into a complex64 padded grid [N + 2S, Nx + 2S]; the wrapper crops it.
//
// What bounds it on the H100.  Per record the accumulation is a complex
// rank-1 update of the S×S subgrid (8·S² flop) and per run the sandwich is
// two complex S×S×S products: 0.52 ms at the main path's 1,046,528 records
// on the CUDA cores in f32 (67 TFLOP/s).  Here they run on the tensor
// cores (989 TFLOP/s fp16, of which mma.sync reaches about half), and
// what is left beside them is the phase factors, 2·S full-precision
// sincosf per record on the CUDA cores, the hi/lo splits and the run
// epilogues: the products and the trig now cost the same order of time.
//
// Design:
// * products on the tensor cores in three passes of split operands, as the
//   reference's split3 tier: each f32 operand x becomes planes hi = fp16(x),
//   lo = fp16(x − hi), and a real product is three mma.sync.m16n8k16
//   passes (hi·hi, hi·lo, lo·hi).  fp16 rather than the reference's bf16:
//   bf16 planes keep 16 bits (6e-6 on the grids, which the image gates
//   amplify tenfold to 1.2e-4, past their 1e-4), fp16 planes 22 bits (~3e-7,
//   tests/test_torch_idg_grid.py::TestSplitF16Numerics).  fp16 needs its
//   range: every operand is scaled by a power of two to below 16, exactly
//   undone in f32 (u per chunk of 32 records, t per run, F by 16·S).  A
//   complex product is two real ones over a stacked depth: re += u_re·e_re
//   + (−u_im)·e_im, im += u_re·e_im + u_im·e_re.  Each 16-deep step goes
//   into zeroed fragments that are then added in f32 (cmma2), because the
//   tensor cores' own accumulation rounds with a bias that grows with the
//   chain;
// * the accumulation a = u·e_xᵀ is a GEMM over chunks of 32 records: the
//   block evaluates u and e_x of a chunk (full-precision sincosf: |ph|
//   reaches ~110 rad, where __sincosf loses accuracy; do not build with
//   --use_fast_math) into hi/lo planes of a two-stage shared-memory ring,
//   laid out for ldmatrix (records contiguous, rows padded to 40), while
//   the products of the chunk before run from the other stage: one barrier
//   a chunk, and two or more resident blocks per SM at S ≤ 64.  The
//   records of the next chunk arrive by cp.async a step ahead;
// * the S×S complex accumulator stays in the warps' mma fragments (a warp
//   owns 16 × 8·NT of it: 32 f32 registers a thread at S = 64);
// * run epilogue: the pair screen (ids clamped to nant − 1, as the TPU
//   kernel does) in f32 on the fragments; t goes to shared memory as hi/lo
//   planes; B = F·t and patch = B·Fᵀ run on the tensor cores with F's hi/lo
//   planes (built once per (S, β, device) by the wrapper; copied into
//   shared memory at S ≤ 64, read through L1 at S = 128); the patch is
//   added with one float2 atomic per cell.  Neighbouring runs' patches
//   overlap, so the sum order on the grid is not fixed;
// * blocks take runs longest first: the launch first sorts the run table
//   by length class (run_order_kernel, a one-block counting sort, 4
//   classes an octave; an argsort through PyTorch cost 0.13 ms, a fifth of
//   the gridder), then block i grids run order[i], so the longest runs
//   start in the first wave and the empty entries come last and exit.
//
// C interface for ctypes: idg_grid_stream() launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <atomic>

#include "split_f16.cuh"

namespace {

constexpr int kChunk = 32;             // records per ring stage
static_assert(kChunk == 32, "a chunk's scale takes one record a lane");
constexpr int kLd = kChunk + 8;        // fp16 row pitch of a chunk plane
constexpr int kPlanes = 8;             // u_re, u_im, e_re, e_im; hi and lo
constexpr int kRecRows = 5;            // dy, dx, w, vis_re, vis_im
constexpr int kClasses = 128;          // run-length classes of the order
constexpr int kOrderThreads = 1024;

// Warp tile 16 × 8·NT of the S×S products, and resident blocks per SM.
template <int S> struct Tile;
template <> struct Tile<32> { static constexpr int NT = 2, kMinBlocks = 4; };
template <> struct Tile<64> { static constexpr int NT = 4, kMinBlocks = 2; };
template <> struct Tile<128> { static constexpr int NT = 8, kMinBlocks = 1; };

template <int S>
struct Geo {
  static constexpr int NT = Tile<S>::NT;
  static constexpr int WM = S / 16, WN = S / (8 * NT);
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kQG = kThreads / 16;     // producer row groups
  static constexpr int kQPer = S / kQG;         // rows per producer thread
  static constexpr int kLdT = S + 8;            // pitch of the epilogue planes
  static constexpr size_t kStage = size_t(kPlanes) * S * kLd;
  static constexpr size_t kRing = 2 * kStage;
  // the epilogue holds t (then B) as 4 planes [S][kLdT], and F's 4 planes
  // beside them where the ring has room (S ≤ 64); at S = 128 F is read
  // through L1
  static constexpr bool kFShared = size_t(8) * S * kLdT <= kRing;
  static constexpr size_t kEpi = size_t(kFShared ? 8 : 4) * S * kLdT;
  static constexpr size_t kRecBytes = 2 * kRecRows * kChunk * sizeof(float);
  static constexpr size_t kSmem =
      kRecBytes + (kRing > kEpi ? kRing : kEpi) * sizeof(__half);
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

// Length class of a run for the block order: 0 for an empty entry, else
// 4·⌊log2 n⌋ + the next two bits of n, + 1 (classes about 19% apart).
__device__ __forceinline__ int length_class(int n) {
  if (n <= 0) return 0;
  const int e = 31 - __clz(n);
  const int m = e >= 2 ? (n >> (e - 2)) & 3 : (n << (2 - e)) & 3;
  return 4 * e + m + 1;
}

// The block order: run-table indices by descending length class (a
// counting sort in one block; the order inside a class is arbitrary).
__global__ void __launch_bounds__(kOrderThreads)
run_order_kernel(const int* __restrict__ starts, const int* __restrict__ ends,
                 int n, int* __restrict__ order) {
  __shared__ int slot[kClasses];
  for (int c = threadIdx.x; c < kClasses; c += blockDim.x) slot[c] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    atomicAdd(&slot[length_class(ends[i] - starts[i])], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int c = kClasses - 1; c >= 0; --c) {
      const int h = slot[c];
      slot[c] = acc;
      acc += h;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    order[atomicAdd(&slot[length_class(ends[i] - starts[i])], 1)] = i;
}

template <int S>
__global__ void __launch_bounds__(Geo<S>::kThreads, Tile<S>::kMinBlocks)
idg_grid_kernel(const float* __restrict__ recs, int64_t n_stride,
                const int* __restrict__ order,
                const int* __restrict__ starts, const int* __restrict__ ends,
                const int* __restrict__ y0s, const int* __restrict__ x0s,
                const int* __restrict__ ia1s, const int* __restrict__ ia2s,
                const float2* __restrict__ scr, int nant,
                const __half* __restrict__ Fp,
                float2* __restrict__ grid, int WP,
                float two_pi_s, float theta_s, float theta_x_s) {
  using G = Geo<S>;
  constexpr int NT = G::NT;
  constexpr int kPlane = S * kLd;          // one chunk plane
  constexpr int kPlaneT = S * G::kLdT;     // one epilogue plane
  const int run = order[blockIdx.x];
  const int start = starts[run];
  const int end = ends[run];
  if (end <= start) return;

  extern __shared__ float4 smem_raw[];
  float* rec_s = reinterpret_cast<float*>(smem_raw);   // [2][5][kChunk]
  __half* smem = reinterpret_cast<__half*>(
      reinterpret_cast<char*>(smem_raw) + G::kRecBytes);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                 // fragment row
  const int t4 = lane & 3;                 // fragment column pair
  const int row0 = (warp % G::WM) * 16;
  const int col0 = (warp / G::WM) * 8 * NT;
  const float pi_f = 3.14159265358979323846f;
  const uint32_t* F32 = reinterpret_cast<const uint32_t*>(Fp);

  float re[NT][4], im[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) re[nt][i] = im[nt][i] = 0.f;

  // ---- records of a chunk, copied a step ahead (zeros past the run) ----
  auto load_records = [&](int c0, int s) {
    float* dst = rec_s + s * kRecRows * kChunk;
    for (int e = tid; e < kRecRows * kChunk; e += G::kThreads) {
      const int row = e / kChunk;
      const int b = e - row * kChunk;
      const bool in = c0 + b < end;
      cp_async4(dst + e, recs + row * n_stride + (in ? c0 + b : 0), in);
    }
  };

  // ---- producer: a chunk's u and e_x as hi/lo planes [S][kLd] ----------
  const int pb = 2 * (tid & 15);           // this thread's record pair
  const int qg = tid >> 4;
  auto produce = [&](const float* rs, __half* st) {
    // the chunk's scale 2^(3 − e), max |v| < 2^e: |u| < 16 in fp16
    const int e = warp_max_exponent(fmaxf(fabsf(rs[3 * kChunk + lane]),
                                          fabsf(rs[4 * kChunk + lane])));
    const float sc = ldexpf(1.f, 3 - e);
    float dy[2], dx[2], w[2], vr[2], vi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {          // v = 0 past the run
      dy[i] = rs[pb + i];
      dx[i] = rs[kChunk + pb + i];
      w[i] = rs[2 * kChunk + pb + i];
      vr[i] = sc * rs[3 * kChunk + pb + i];
      vi[i] = sc * rs[4 * kChunk + pb + i];
    }
#pragma unroll
    for (int j = 0; j < G::kQPer; ++j) {
      const int q = qg + G::kQG * j;
      const float cq = float(q - S / 2);
      const float ly = cq * theta_s;
      const float lx = cq * theta_x_s;
      float ur[2], ui[2], er[2], ei[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float ph_y = two_pi_s * cq * dy[i] - pi_f * (ly * ly) * w[i];
        const float ph_x = two_pi_s * cq * dx[i] - pi_f * (lx * lx) * w[i];
        float sy, cy;
        sincosf(ph_y, &sy, &cy);
        sincosf(ph_x, &ei[i], &er[i]);
        ur[i] = cy * vr[i] - sy * vi[i];
        ui[i] = cy * vi[i] + sy * vr[i];
      }
      __half* p = st + q * kLd + pb;
      store_split(p, p + kPlane, ur[0], ur[1]);
      store_split(p + 2 * kPlane, p + 3 * kPlane, ui[0], ui[1]);
      store_split(p + 4 * kPlane, p + 5 * kPlane, er[0], er[1]);
      store_split(p + 6 * kPlane, p + 7 * kPlane, ei[0], ei[1]);
    }
    return ldexpf(1.f, e - 3);             // undoes the scale
  };

  // ---- consumer: acc += u·e_xᵀ over one chunk -------------------------
  auto consume = [&](const __half* st, float unscale) {
    const __half* E = st + 4 * kPlane;
#pragma unroll 1
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      uint32_t a[4][4], na[2][4];
      const __half* pa =
          st + (row0 + (lane & 15)) * kLd + ks * 16 + (lane >> 4) * 8;
#pragma unroll
      for (int p = 0; p < 4; ++p) ldsm_x4(a[p], pa + p * kPlane);
      negate(na, a);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[2][4][2];
        const __half* pe =
            E + (col0 + np * 16 + (lane >> 4) * 8 + (lane & 7)) * kLd +
            ks * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t r[4];
          ldsm_x4(r, pe + p * kPlane);
          b[0][p][0] = r[0];
          b[0][p][1] = r[1];
          b[1][p][0] = r[2];
          b[1][p][1] = r[3];
        }
        cmma2(re, im, 2 * np, a, na, b, unscale);
      }
    }
  };

  // Step k fills ring stage k & 1 with chunk k and multiplies chunk k − 1
  // out of the other stage, one barrier a step; the records of chunk k + 1
  // arrive meanwhile.  (One call site of each keeps the code small: the
  // trig loop is unrolled, 16 inlined sincosf, for 7% on the H100; the
  // 16-record steps are not, which holds the registers under the cap of
  // two blocks an SM.)
  const int n_chunks = (end - start + kChunk - 1) / kChunk;
  load_records(start, 0);
  cp_async_wait_all();
  __syncthreads();
  float unscale = 1.f;                     // of the chunk in the ring
#pragma unroll 1
  for (int k = 0; k <= n_chunks; ++k) {
    if (k + 1 < n_chunks) load_records(start + (k + 1) * kChunk, (k + 1) & 1);
    float next = unscale;
    if (k < n_chunks)
      next = produce(rec_s + (k & 1) * kRecRows * kChunk,
                     smem + (k & 1) * G::kStage);
    if (k > 0) consume(smem + ((k - 1) & 1) * G::kStage, unscale);
    unscale = next;
    cp_async_wait_all();
    __syncthreads();
  }

  // ---- run epilogue ----------------------------------------------------
  __half* T = smem;                 // t, then B: 4 planes [S][kLdT]
  __half* Fs = smem + 4 * kPlaneT;  // F's 4 planes (kFShared)
  if constexpr (G::kFShared) {
    // F's planes into shared memory, 16 bytes a copy, while the screen runs
    constexpr int kRow16 = S / 8;
    for (int e = tid; e < 4 * S * kRow16; e += G::kThreads) {
      const int y = e / kRow16;            // plane-major rows
      const int c = e - y * kRow16;
      cp_async16(Fs + y * G::kLdT + c * 8, Fp + y * S + c * 8);
    }
  }
  int e_t;                                 // max |t| < 2^e_t
  {
    // t = a ∘ conj(A1·A2) in f32 on the fragments, in place
    const int i1 = max(0, min(ia1s[run], nant - 1));
    const int i2 = max(0, min(ia2s[run], nant - 1));
    const float2* A1 = scr + size_t(i1) * S * S;
    const float2* A2 = scr + size_t(i2) * S * S;
    float m = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = row0 + g + 8 * h;
        const int r = col0 + nt * 8 + 2 * t4;
        const float4 s1 = __ldg(reinterpret_cast<const float4*>(
            A1 + q * S + r));
        const float4 s2 = __ldg(reinterpret_cast<const float4*>(
            A2 + q * S + r));
        // conj(a1·a2) at (q, r) and (q, r + 1)
        const float pr[2] = {s1.x * s2.x - s1.y * s2.y,
                             s1.z * s2.z - s1.w * s2.w};
        const float pi[2] = {-(s1.x * s2.y + s1.y * s2.x),
                             -(s1.z * s2.w + s1.w * s2.z)};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float ar = re[nt][2 * h + c], ai = im[nt][2 * h + c];
          re[nt][2 * h + c] = ar * pr[c] - ai * pi[c];
          im[nt][2 * h + c] = ar * pi[c] + ai * pr[c];
          m = fmaxf(m, fmaxf(fabsf(re[nt][2 * h + c]),
                             fabsf(im[nt][2 * h + c])));
        }
      }
    // the run's scale 2^(4 − e_t), max |t| < 2^e_t: |t| < 16 in fp16
    __shared__ int e_warp[32];
    e_t = warp_max_exponent(m);
    if (lane == 0) e_warp[warp] = e_t;
    __syncthreads();
    for (int i = 0; i < G::kThreads / 32; ++i) e_t = max(e_t, e_warp[i]);
    const float sc = ldexpf(1.f, 4 - e_t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __half* p = T + (row0 + g + 8 * h) * G::kLdT + col0 + nt * 8 + 2 * t4;
        store_split(p, p + kPlaneT, sc * re[nt][2 * h],
                    sc * re[nt][2 * h + 1]);
        store_split(p + 2 * kPlaneT, p + 3 * kPlaneT, sc * im[nt][2 * h],
                    sc * im[nt][2 * h + 1]);
        re[nt][2 * h] = re[nt][2 * h + 1] = 0.f;
        im[nt][2 * h] = im[nt][2 * h + 1] = 0.f;
      }
  }
  cp_async_wait_all();
  __syncthreads();

  // F's A fragments (rows y, depth k) and B fragments (rows x, depth k)
  auto f_a = [&](uint32_t (&a)[4][4], int y0f, int k0) {
    if constexpr (G::kFShared) {
      const __half* pa =
          Fs + (y0f + (lane & 15)) * G::kLdT + k0 + (lane >> 4) * 8;
#pragma unroll
      for (int p = 0; p < 4; ++p) ldsm_x4(a[p], pa + p * kPlaneT);
    } else {
      const int y = y0f + g;
      const int kk = k0 + 2 * t4;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint32_t* f = F32 + p * (S * S / 2);
        a[p][0] = __ldg(f + (y * S + kk) / 2);
        a[p][1] = __ldg(f + ((y + 8) * S + kk) / 2);
        a[p][2] = __ldg(f + (y * S + kk + 8) / 2);
        a[p][3] = __ldg(f + ((y + 8) * S + kk + 8) / 2);
      }
    }
  };
  auto f_b = [&](uint32_t (&b)[2][4][2], int x0f, int k0) {
    if constexpr (G::kFShared) {
      const __half* pb_ =
          Fs + (x0f + (lane >> 4) * 8 + (lane & 7)) * G::kLdT + k0 +
          ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t r[4];
        ldsm_x4(r, pb_ + p * kPlaneT);
        b[0][p][0] = r[0];
        b[0][p][1] = r[1];
        b[1][p][0] = r[2];
        b[1][p][1] = r[3];
      }
    } else {
      const int kk = k0 + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = x0f + h * 8 + g;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const uint32_t* f = F32 + p * (S * S / 2);
          b[h][p][0] = __ldg(f + (x * S + kk) / 2);
          b[h][p][1] = __ldg(f + (x * S + kk + 8) / 2);
        }
      }
    }
  };

  // ---- B = F·t: A = F (rows y, depth q), B = t (depth q, columns r) ----
#pragma unroll 1
  for (int ks = 0; ks < S / 16; ++ks) {
    uint32_t a[4][4], na[2][4];
    f_a(a, row0, ks * 16);
    negate(na, a);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[2][4][2];
      const __half* pt =
          T + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * G::kLdT +
          col0 + np * 16 + (lane >> 4) * 8;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t r[4];
        ldsm_x4_t(r, pt + p * kPlaneT);
        b[0][p][0] = r[0];
        b[0][p][1] = r[1];
        b[1][p][0] = r[2];
        b[1][p][1] = r[3];
      }
      cmma2(re, im, 2 * np, a, na, b, 1.f);
    }
  }
  __syncthreads();                         // t consumed
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = row0 + g + 8 * h;
      const int r = col0 + nt * 8 + 2 * t4;
      __half* p = T + y * G::kLdT + r;
      store_split(p, p + kPlaneT, re[nt][2 * h],
                  re[nt][2 * h + 1]);
      store_split(p + 2 * kPlaneT, p + 3 * kPlaneT, im[nt][2 * h],
                  im[nt][2 * h + 1]);
      re[nt][2 * h] = re[nt][2 * h + 1] = 0.f;
      im[nt][2 * h] = im[nt][2 * h + 1] = 0.f;
    }
  __syncthreads();

  // ---- patch = B·Fᵀ: A = B (rows y, depth r), B = F (rows x, depth r) --
#pragma unroll 1
  for (int ks = 0; ks < S / 16; ++ks) {
    uint32_t a[4][4], na[2][4];
    const __half* pa =
        T + (row0 + (lane & 15)) * G::kLdT + ks * 16 + (lane >> 4) * 8;
#pragma unroll
    for (int p = 0; p < 4; ++p) ldsm_x4(a[p], pa + p * kPlaneT);
    negate(na, a);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[2][4][2];
      f_b(b, col0 + np * 16, ks * 16);
      cmma2(re, im, 2 * np, a, na, b, 1.f);
    }
  }

  // patch = that product / (256·S²·2^(4 − e_t)): F's planes hold 16·S·F
  const float ps = ldexpf(1.f, e_t - 12) / float(S * S);
  const int y0 = y0s[run];
  const int x0 = x0s[run];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = row0 + g + 8 * h;
      const int x = col0 + nt * 8 + 2 * t4;
      float2* p = grid + size_t(y0 + y) * WP + x0 + x;
      atomic_add_c(p, make_float2(ps * re[nt][2 * h], ps * im[nt][2 * h]));
      atomic_add_c(p + 1, make_float2(ps * re[nt][2 * h + 1],
                                      ps * im[nt][2 * h + 1]));
    }
}

// The kernel's shared-memory attributes, set once per template instance and
// device (they are driver calls, and every gridding call passes here); a
// failure is returned and tried again on the next call.
template <int S>
cudaError_t set_attributes() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(idg_grid_kernel<S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(Geo<S>::kSmem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(idg_grid_kernel<S>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

template <int S>
cudaError_t launch(const float* recs, int64_t n_stride, int* order,
                   const int* starts, const int* ends, const int* y0,
                   const int* x0, const int* ia1, const int* ia2, int n_runs,
                   const float2* scr, int nant, const __half* Fp,
                   float2* grid, int WP, float two_pi_s, float theta_s,
                   float theta_x_s, cudaStream_t stream) {
  using G = Geo<S>;
  const cudaError_t err = set_attributes<S>();
  if (err != cudaSuccess) return err;
  run_order_kernel<<<1, kOrderThreads, 0, stream>>>(starts, ends, n_runs,
                                                     order);
  idg_grid_kernel<S><<<n_runs, G::kThreads, G::kSmem, stream>>>(
      recs, n_stride, order, starts, ends, y0, x0, ia1, ia2, scr, nant, Fp,
      grid, WP, two_pi_s, theta_s, theta_x_s);
  return cudaGetLastError();
}

}  // namespace

extern "C" int idg_grid_stream(const void* recs, long long n_stride,
                               void* order, const void* starts,
                               const void* ends, const void* y0,
                               const void* x0, const void* ia1,
                               const void* ia2, int n_runs,
                               const void* screens, int nant,
                               const void* F_planes, void* grid, int WP,
                               int S, float two_pi_s, float theta_s,
                               float theta_x_s, void* stream) {
  if (n_runs <= 0) return int(cudaGetLastError());
  auto r = static_cast<const float*>(recs);
  auto od = static_cast<int*>(order);
  auto st = static_cast<const int*>(starts);
  auto en = static_cast<const int*>(ends);
  auto yy = static_cast<const int*>(y0);
  auto xx = static_cast<const int*>(x0);
  auto a1 = static_cast<const int*>(ia1);
  auto a2 = static_cast<const int*>(ia2);
  auto sc = static_cast<const float2*>(screens);
  auto fp = static_cast<const __half*>(F_planes);
  auto g = static_cast<float2*>(grid);
  auto s = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 32:
      return int(launch<32>(r, n_stride, od, st, en, yy, xx, a1, a2, n_runs,
                            sc, nant, fp, g, WP, two_pi_s, theta_s,
                            theta_x_s, s));
    case 64:
      return int(launch<64>(r, n_stride, od, st, en, yy, xx, a1, a2, n_runs,
                            sc, nant, fp, g, WP, two_pi_s, theta_s,
                            theta_x_s, s));
    case 128:
      return int(launch<128>(r, n_stride, od, st, en, yy, xx, a1, a2,
                             n_runs, sc, nant, fp, g, WP, two_pi_s, theta_s,
                             theta_x_s, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* idg_grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
