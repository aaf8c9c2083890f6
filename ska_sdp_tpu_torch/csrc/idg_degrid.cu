// Streamed IDG(-AW) degridder for NVIDIA Hopper (sm_90a), on the tensor
// cores.
//
// Replaces three TPU kernels of ska_sdp_tpu/kernels/ (one operator):
//   #2 idg_aw_stream_pallas.py::_degrid_kernel (idg_aw_degrid_stream);
//   #4 idg_aw_stream_pallas.py::idg_aw_degrid_banded, whose bands exist to
//      fit the grid into VMEM: here the model grid in device memory serves
//      every run;
//   #6 idg_aw_degrid_pallas.py::_kernel, the run-major variant: its
//      head/main block protocol and unsort epilogue exist for the TPU's
//      block DMA; here each visibility is written once to its original
//      index (parity: tests/test_torch_spectral.py::TestRunMajorFold).
// Same operator, the exact adjoint of idg_grid.cu: records are sorted into
// runs sharing one antenna pair and one uv tile; per run r with origin
// (y0, x0) in the padded grid [N + 2S, Nx + 2S] (the complex64 model grid
// [N, Nx] sits at offset S, zero around it) and subgrid size S,
//
//   W         = padded[y0 : y0 + S, x0 : x0 + S]
//   T         = Fᴴ·W·conj(F)    F[y,q] = e^{−2πi(y−S/2)(q−S/2)/S}/S · taper[q]
//   I         = T ∘ (A[ia1]·A[ia2])                     (pair screen, unconjugated)
//   ph_y[q,b] = 2π/S·c_q·dy_b − π·(c_q·θ/S)²·w_b        c_q = q − S/2
//   ph_x[r,b] = 2π/S·c_r·dx_b − π·(c_r·θ_x/S)²·w_b
//   v_b       = Σ_q e^{−i·ph_y[q,b]} · Σ_r I[q,r]·e^{−i·ph_x[r,b]}
//
// for each record b in [starts[r], ends[r]), written to out[order_s[b]].
//
// What bounds it on the H100.  Per record the contraction over r is a
// complex S-deep product for each of S rows (8·S² flop) and per run the
// sandwich two complex S×S×S products: 0.52 ms at the main path's
// 1,046,528 records on the CUDA cores in f32 (67 TFLOP/s).  Here the
// products run on the tensor cores (989 TFLOP/s fp16, of which mma.sync
// reaches about half), and what is left beside them is the phase factors,
// 2·S full-precision sincosf per record on the CUDA cores, the hi/lo
// splits, the conj(e_y) weighting and the run prologues.
//
// Design (the arithmetic of idg_grid.cu, carried to the adjoint; the
// split-fp16 helpers are shared through split_f16.cuh):
// * products on the tensor cores in three passes of split-fp16 operands
//   (hi·hi, hi·lo, lo·hi), every operand scaled by a power of two to below
//   16 and the scale undone exactly in f32: the window W, the sandwich's
//   middle product B and the run image I each per run (a block-wide max),
//   the phase factors by 8 (|e| ≤ 1), Fᴴ by 16·S (its planes are built
//   once per (S, β, device) by the wrapper).  Each 16-deep step goes into
//   zeroed fragments that are then added in f32 (cmma2).  Split-bf16
//   planes keep 16 bits, too few for the image gates (see idg_grid.cu),
//   and a predict feeds the major cycle's residual images;
// * run prologue: W is read from the model grid (zero outside it, so the
//   wrapper builds no padded copy) and staged as hi/lo planes; B = Fᴴ·W
//   (A = Fᴴ's planes, B read transposed from W's), then T = B·conj(F)
//   (A = B's planes, the other operand Fᴴ's planes read as [r][x] rows),
//   with Fᴴ's planes in shared memory at S ≤ 64 and read through L1 at
//   S = 128; the pair
//   screen in f32 on T's fragments gives I, stored as hi/lo planes [q][r]
//   in the buffer that held W and then B;
// * records are taken 32 at a time through a two-stage shared-memory ring:
//   the block evaluates 8·conj(e_x) of chunk k (full-precision sincosf:
//   |ph| reaches ~110 rad, where __sincosf loses accuracy; do not build
//   with --use_fast_math) into hi/lo planes [b][r] while the products of
//   chunk k − 1 run from the other stage, one barrier a chunk; the records
//   of chunk k + 1 arrive meanwhile by cp.async (a three-stage record ring,
//   since the products read dy and w of their own chunk);
// * the contraction t = I·conj(E_x) (M = q, N = the chunk's 32 records,
//   K = r) runs as mma.m16n8k16, a warp owning 16 rows × 16 records; the
//   conj(e_y) weighting stays in f32 on the accumulator fragments (each
//   thread evaluates e_y at its own fragment's (q, b), so e_y needs no
//   shared memory), then a warp-shuffle sum over the warp's rows and a
//   fixed-order sum of the S/16 row warps in shared memory;
// * each record is written exactly once, straight to its original index,
//   so the output needs no atomics or unsort pass and is the same from run
//   to run.  Sentinel runs (out-of-bounds and unfit records, pair id 2¹⁵)
//   are skipped and records past the run table belong to no run: the
//   wrapper's zero-filled output keeps all of them at exactly 0, as the
//   reference's `use` mask does.  Blocks take runs in table order.
//
// C interface for ctypes: idg_degrid_stream() launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <atomic>

#include "split_f16.cuh"

namespace {

constexpr int kChunk = 32;               // records per ring stage
static_assert(kChunk == 32, "the final sum takes one record a thread");
constexpr int kRecRows = 3;              // dy, dx, w
constexpr int kRecStages = 3;
constexpr int kPairShift = 1 << 15;      // sentinel runs decode ia1 = 2¹⁵

// Resident blocks per SM.
template <int S> struct Tile;
template <> struct Tile<32> { static constexpr int kMinBlocks = 4; };
template <> struct Tile<64> { static constexpr int kMinBlocks = 2; };
template <> struct Tile<128> { static constexpr int kMinBlocks = 1; };

// Warps: S/16 rows of 16 (WM) by 2 columns (WN).  In the sandwich a warp
// owns 16 rows × S/2 columns (NT tiles of 8), in the contraction 16 rows ×
// 16 records.
template <int S>
struct Geo {
  static constexpr int WM = S / 16, WN = 2, NT = S / 16;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kLd = S + 8;             // fp16 pitch of a plane row
  static constexpr int kPlane = S * kLd;        // an S×S plane
  static constexpr int kPlaneE = kChunk * kLd;  // a chunk plane [b][r]
  static constexpr bool kHShared = S <= 64;
  static constexpr size_t kImg = 4 * size_t(kPlane);     // W, then B, then I
  static constexpr size_t kRing = 2 * 4 * size_t(kPlaneE);
  static constexpr size_t kH = kHShared ? 4 * size_t(kPlane) : 0;
  static constexpr size_t kHalves = kImg + (kRing > kH ? kRing : kH);
  static constexpr size_t kRecBytes =
      size_t(kRecStages) * kRecRows * kChunk * sizeof(float);
  static constexpr size_t kRedBytes = 2 * size_t(WM) * kChunk * sizeof(float2);
  static constexpr size_t kSmem =
      kHalves * sizeof(__half) + kRecBytes + kRedBytes;
};

// The exponent e of the block's largest m ≥ 0 (warp_max_exponent), through
// `slots` (one int a warp).  Ends with a barrier.
__device__ __forceinline__ int block_max_exponent(float m, int* slots,
                                                  int warps) {
  const int e = warp_max_exponent(m);
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = e;
  __syncthreads();
  int r = -120;
  for (int i = 0; i < warps; ++i) r = max(r, slots[i]);
  return r;
}

template <int S>
__global__ void __launch_bounds__(Geo<S>::kThreads, Tile<S>::kMinBlocks)
idg_degrid_kernel(const float* __restrict__ recs, int64_t n_stride,
                  const int* __restrict__ starts, const int* __restrict__ ends,
                  const int* __restrict__ y0s, const int* __restrict__ x0s,
                  const int* __restrict__ ia1s, const int* __restrict__ ia2s,
                  const int* __restrict__ order,
                  const float2* __restrict__ scr, int nant,
                  const __half* __restrict__ Hp,
                  const float2* __restrict__ grid, int N, int Nx,
                  float two_pi_s, float theta_s, float theta_x_s,
                  float2* __restrict__ out) {
  using G = Geo<S>;
  constexpr int NT = G::NT;
  constexpr int kLd = G::kLd;
  constexpr int kPlane = G::kPlane;
  constexpr int kPlaneE = G::kPlaneE;
  constexpr int kWarps = G::kThreads / 32;
  const int run = blockIdx.x;
  const int start = starts[run];
  const int end = ends[run];
  if (end <= start || ia1s[run] >= kPairShift) return;

  extern __shared__ float4 smem_raw[];
  __half* img = reinterpret_cast<__half*>(smem_raw);   // 4 planes [S][kLd]
  __half* aux = img + G::kImg;                          // Fᴴ, then the ring
  float* rec_s = reinterpret_cast<float*>(img + G::kHalves);
  float2* red_s = reinterpret_cast<float2*>(
      rec_s + kRecStages * kRecRows * kChunk);          // [2][WM][kChunk]
  __shared__ int e_slots[3][32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                 // fragment row
  const int t4 = lane & 3;                 // fragment column pair
  const int wm = warp % G::WM;
  const int row0 = wm * 16;
  const int col0 = (warp / G::WM) * (S / 2);   // sandwich columns
  const int rcol0 = (warp / G::WM) * 16;       // contraction records
  const float pi_f = 3.14159265358979323846f;
  const uint32_t* H32 = reinterpret_cast<const uint32_t*>(Hp);

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

  // Fᴴ's A fragments (rows q, depth k) and B fragments (rows n, depth k)
  auto h_a = [&](uint32_t (&a)[4][4], int r0, int k0) {
    if constexpr (G::kHShared) {
      const __half* pa = aux + (r0 + (lane & 15)) * kLd + k0 + (lane >> 4) * 8;
#pragma unroll
      for (int p = 0; p < 4; ++p) ldsm_x4(a[p], pa + p * kPlane);
    } else {
      const int y = r0 + g;
      const int kk = k0 + 2 * t4;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint32_t* f = H32 + p * (S * S / 2);
        a[p][0] = __ldg(f + (y * S + kk) / 2);
        a[p][1] = __ldg(f + ((y + 8) * S + kk) / 2);
        a[p][2] = __ldg(f + (y * S + kk + 8) / 2);
        a[p][3] = __ldg(f + ((y + 8) * S + kk + 8) / 2);
      }
    }
  };
  auto h_b = [&](uint32_t (&b)[2][4][2], int n0, int k0) {
    if constexpr (G::kHShared) {
      const __half* pb = aux + (n0 + (lane >> 4) * 8 + (lane & 7)) * kLd +
                         k0 + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t r[4];
        ldsm_x4(r, pb + p * kPlane);
        b[0][p][0] = r[0];
        b[0][p][1] = r[1];
        b[1][p][0] = r[2];
        b[1][p][1] = r[3];
      }
    } else {
      const int kk = k0 + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = n0 + h * 8 + g;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const uint32_t* f = H32 + p * (S * S / 2);
          b[h][p][0] = __ldg(f + (x * S + kk) / 2);
          b[h][p][1] = __ldg(f + (x * S + kk + 8) / 2);
        }
      }
    }
  };

  // ---- run prologue: window, adjoint sandwich, pair screen --------------
  load_records(start, 0);
  if constexpr (G::kHShared) {
    // Fᴴ's planes into shared memory, 16 bytes a copy, while W is read
    constexpr int kRow16 = S / 8;
    for (int e = tid; e < 4 * S * kRow16; e += G::kThreads) {
      const int y = e / kRow16;            // plane-major rows
      const int c = e - y * kRow16;
      cp_async16(aux + y * kLd + c * 8, Hp + y * S + c * 8);
    }
  }
  // the window's cell (y, x): the model grid's, 0 outside it
  const int wy0 = y0s[run] - S, wx0 = x0s[run] - S;
  auto cell = [&](int y, int x) {
    const int gy = wy0 + y, gx = wx0 + x;
    return gy >= 0 && gy < N && gx >= 0 && gx < Nx
               ? __ldg(grid + size_t(gy) * Nx + gx) : make_float2(0.f, 0.f);
  };
  float m = 0.f;
  for (int e = tid; e < S * S / 2; e += G::kThreads) {
    const int y = e / (S / 2);
    const int x = 2 * (e - y * (S / 2));
    const float2 a = cell(y, x);
    const float2 b = cell(y, x + 1);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)),
                       fmaxf(fabsf(b.x), fabsf(b.y))));
  }
  // W's scale 2^(4 − e_w), max |W| < 2^e_w: |W| < 16 in fp16
  const int e_w = block_max_exponent(m, e_slots[0], kWarps);
  {
    const float sw = ldexpf(1.f, 4 - e_w);
    for (int e = tid; e < S * S / 2; e += G::kThreads) {
      const int y = e / (S / 2);
      const int x = 2 * (e - y * (S / 2));
      const float2 a = cell(y, x);
      const float2 b = cell(y, x + 1);
      __half* p = img + y * kLd + x;
      store_split(p, p + kPlane, sw * a.x, sw * b.x);
      store_split(p + 2 * kPlane, p + 3 * kPlane, sw * a.y, sw * b.y);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  float re[NT][4], im[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) re[nt][i] = im[nt][i] = 0.f;
  // B = Fᴴ·W: A = Fᴴ (rows q, depth y), B = W (depth y, columns x)
#pragma unroll 1
  for (int ks = 0; ks < S / 16; ++ks) {
    uint32_t a[4][4], na[2][4];
    h_a(a, row0, ks * 16);
    negate(na, a);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[2][4][2];
      const __half* pt =
          img + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLd +
          col0 + np * 16 + (lane >> 4) * 8;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t r[4];
        ldsm_x4_t(r, pt + p * kPlane);
        b[0][p][0] = r[0];
        b[0][p][1] = r[1];
        b[1][p][0] = r[2];
        b[1][p][1] = r[3];
      }
      cmma2(re, im, 2 * np, a, na, b, 1.f);
    }
  }
  // B's scale 2^(4 − e_b); the barrier also ends every read of W
  m = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      m = fmaxf(m, fmaxf(fabsf(re[nt][i]), fabsf(im[nt][i])));
  const int e_b = block_max_exponent(m, e_slots[1], kWarps);
  {
    const float sb = ldexpf(1.f, 4 - e_b);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __half* p = img + (row0 + g + 8 * h) * kLd + col0 + nt * 8 + 2 * t4;
        store_split(p, p + kPlane, sb * re[nt][2 * h],
                    sb * re[nt][2 * h + 1]);
        store_split(p + 2 * kPlane, p + 3 * kPlane, sb * im[nt][2 * h],
                    sb * im[nt][2 * h + 1]);
        re[nt][2 * h] = re[nt][2 * h + 1] = 0.f;
        im[nt][2 * h] = im[nt][2 * h + 1] = 0.f;
      }
  }
  __syncthreads();
  // T = B·conj(F): A = B (rows q, depth x), B = Fᴴ read as rows r, depth x
#pragma unroll 1
  for (int ks = 0; ks < S / 16; ++ks) {
    uint32_t a[4][4], na[2][4];
    const __half* pa = img + (row0 + (lane & 15)) * kLd + ks * 16 +
                       (lane >> 4) * 8;
#pragma unroll
    for (int p = 0; p < 4; ++p) ldsm_x4(a[p], pa + p * kPlane);
    negate(na, a);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[2][4][2];
      h_b(b, col0 + np * 16, ks * 16);
      cmma2(re, im, 2 * np, a, na, b, 1.f);
    }
  }
  // I = T ∘ (A1·A2) in f32 on the fragments: T is the product above /
  // ((16·S)²·2^(4 − e_w)·2^(4 − e_b)), Fᴴ's planes holding 16·S·Fᴴ
  {
    const float s1 = ldexpf(1.f, e_b - 4) / float(256 * S * S);
    const float s2 = ldexpf(1.f, e_w - 4);
    const int i1 = max(0, min(ia1s[run], nant - 1));
    const int i2 = max(0, min(ia2s[run], nant - 1));
    const float2* A1 = scr + size_t(i1) * S * S;
    const float2* A2 = scr + size_t(i2) * S * S;
    m = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = row0 + g + 8 * h;
        const int r = col0 + nt * 8 + 2 * t4;
        const float4 u1 = __ldg(reinterpret_cast<const float4*>(
            A1 + q * S + r));
        const float4 u2 = __ldg(reinterpret_cast<const float4*>(
            A2 + q * S + r));
        // a1·a2 at (q, r) and (q, r + 1)
        const float pr[2] = {u1.x * u2.x - u1.y * u2.y,
                             u1.z * u2.z - u1.w * u2.w};
        const float pi[2] = {u1.x * u2.y + u1.y * u2.x,
                             u1.z * u2.w + u1.w * u2.z};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float tr = re[nt][2 * h + c] * s1 * s2;
          const float ti = im[nt][2 * h + c] * s1 * s2;
          re[nt][2 * h + c] = tr * pr[c] - ti * pi[c];
          im[nt][2 * h + c] = tr * pi[c] + ti * pr[c];
          m = fmaxf(m, fmaxf(fabsf(re[nt][2 * h + c]),
                             fabsf(im[nt][2 * h + c])));
        }
      }
  }
  // I's scale 2^(4 − e_i); the barrier also ends every read of B and Fᴴ
  const int e_i = block_max_exponent(m, e_slots[2], kWarps);
  {
    const float si = ldexpf(1.f, 4 - e_i);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __half* p = img + (row0 + g + 8 * h) * kLd + col0 + nt * 8 + 2 * t4;
        store_split(p, p + kPlane, si * re[nt][2 * h],
                    si * re[nt][2 * h + 1]);
        store_split(p + 2 * kPlane, p + 3 * kPlane, si * im[nt][2 * h],
                    si * im[nt][2 * h + 1]);
      }
  }
  __syncthreads();
  // v = (Σ over the products of I·2^(4 − e_i) and 8·conj(e_x)) · 2^(e_i − 7)
  const float vs = ldexpf(1.f, e_i - 7);

  // ---- producer: a chunk's 8·conj(e_x) as hi/lo planes [b][r] ----------
  const int pr2 = 2 * (tid % (S / 2));     // this thread's pair of r
  const int pb0 = tid / (S / 2);           // and first record
  auto produce = [&](const float* rs, __half* st) {
    float two_c[2], kx[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float cr = float(pr2 + i - S / 2);
      const float lx = cr * theta_x_s;
      two_c[i] = two_pi_s * cr;
      kx[i] = pi_f * (lx * lx);
    }
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
      const int b = pb0 + 8 * j;
      const float dx = rs[kChunk + b];
      const float w = rs[2 * kChunk + b];
      float s[2], c[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) sincosf(two_c[i] * dx - kx[i] * w, &s[i],
                                          &c[i]);
      __half* p = st + b * kLd + pr2;
      store_split(p, p + kPlaneE, 8.f * c[0], 8.f * c[1]);
      store_split(p + 2 * kPlaneE, p + 3 * kPlaneE, -8.f * s[0],
                  -8.f * s[1]);
    }
  };

  // ---- consumer: t = I·conj(E_x), weighted by conj(e_y) ----------------
  auto consume = [&](const __half* st, const float* rs, float2* red) {
    float tre[2][4], tim[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) tre[nt][i] = tim[nt][i] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < S / 16; ++ks) {
      uint32_t a[4][4], na[2][4], b[2][4][2];
      const __half* pa = img + (row0 + (lane & 15)) * kLd + ks * 16 +
                         (lane >> 4) * 8;
#pragma unroll
      for (int p = 0; p < 4; ++p) ldsm_x4(a[p], pa + p * kPlane);
      negate(na, a);
      const __half* pe = st + (rcol0 + (lane >> 4) * 8 + (lane & 7)) * kLd +
                         ks * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t r[4];
        ldsm_x4(r, pe + p * kPlaneE);
        b[0][p][0] = r[0];
        b[0][p][1] = r[1];
        b[1][p][0] = r[2];
        b[1][p][1] = r[3];
      }
      cmma2(tre, tim, 0, a, na, b, 1.f);
    }
    // conj(e_y[q, b])·t[q, b] summed over this thread's rows q
    float2 part[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) part[nt][c] = make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float cq = float(row0 + g + 8 * h - S / 2);
      const float ly = cq * theta_s;
      const float two_c = two_pi_s * cq;
      const float ky = pi_f * (ly * ly);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int b = rcol0 + nt * 8 + 2 * t4 + c;
          float s, co;
          sincosf(two_c * rs[b] - ky * rs[2 * kChunk + b], &s, &co);
          const float tr = tre[nt][2 * h + c], ti = tim[nt][2 * h + c];
          part[nt][c].x = fmaf(co, tr, fmaf(s, ti, part[nt][c].x));
          part[nt][c].y = fmaf(co, ti, fmaf(-s, tr, part[nt][c].y));
        }
    }
    // over the warp's 8 row groups, then one entry a (row warp, record)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          part[nt][c].x += __shfl_xor_sync(0xffffffffu, part[nt][c].x, o);
          part[nt][c].y += __shfl_xor_sync(0xffffffffu, part[nt][c].y, o);
        }
    if (g == 0) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          red[wm * kChunk + rcol0 + nt * 8 + 2 * t4 + c] = part[nt][c];
    }
  };

  // Step k fills ring stage k & 1 with chunk k and multiplies chunk k − 1
  // out of the other stage, one barrier a step; the records of chunk
  // k + 1 arrive meanwhile, and the sums of chunk k − 1 are written after
  // the barrier.
  const int n_chunks = (end - start + kChunk - 1) / kChunk;
#pragma unroll 1
  for (int k = 0; k <= n_chunks; ++k) {
    if (k + 1 < n_chunks)
      load_records(start + (k + 1) * kChunk, (k + 1) % kRecStages);
    if (k < n_chunks)
      produce(rec_s + (k % kRecStages) * kRecRows * kChunk,
              aux + (k & 1) * 4 * kPlaneE);
    if (k > 0)
      consume(aux + ((k - 1) & 1) * 4 * kPlaneE,
              rec_s + ((k - 1) % kRecStages) * kRecRows * kChunk,
              red_s + ((k - 1) & 1) * G::WM * kChunk);
    cp_async_wait_all();
    __syncthreads();
    if (k > 0 && tid < kChunk) {
      const int b = start + (k - 1) * kChunk + tid;
      if (b < end) {
        const float2* red = red_s + ((k - 1) & 1) * G::WM * kChunk;
        float2 v = red[tid];
#pragma unroll
        for (int i = 1; i < G::WM; ++i) {
          v.x += red[i * kChunk + tid].x;
          v.y += red[i * kChunk + tid].y;
        }
        out[order[b]] = make_float2(vs * v.x, vs * v.y);
      }
    }
  }
}

// The kernel's shared-memory attributes, set once per template instance and
// device (they are runtime API calls, and every degridding call passes
// here); a failure is cleared from the runtime's last error, so that the
// next launch reports only its own, returned, and tried again on the next
// call.
template <int S>
cudaError_t set_attributes() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < kMaxDevices &&
      done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(idg_degrid_kernel<S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(Geo<S>::kSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(idg_degrid_kernel<S>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (dev < kMaxDevices) done[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

template <int S>
cudaError_t launch(const float* recs, int64_t n_stride, const int* starts,
                   const int* ends, const int* y0, const int* x0,
                   const int* ia1, const int* ia2, int n_runs,
                   const int* order, const float2* scr, int nant,
                   const __half* Hp, const float2* grid, int N, int Nx,
                   float two_pi_s, float theta_s, float theta_x_s,
                   float2* out, cudaStream_t stream) {
  using G = Geo<S>;
  const cudaError_t err = set_attributes<S>();
  if (err != cudaSuccess) return err;
  idg_degrid_kernel<S><<<n_runs, G::kThreads, G::kSmem, stream>>>(
      recs, n_stride, starts, ends, y0, x0, ia1, ia2, order, scr, nant, Hp,
      grid, N, Nx, two_pi_s, theta_s, theta_x_s, out);
  return cudaGetLastError();
}

}  // namespace

// H_planes: [4, S, S] fp16, the hi/lo planes (re hi, re lo, im hi, im lo)
// of 16·S·Fᴴ (kernels/idg_aw_stream.py::_dft_planes_adjoint); grid: the
// [N, Nx] complex64 model grid, contiguous; y0, x0: run origins in the
// padded grid [N + 2S, Nx + 2S].
extern "C" int idg_degrid_stream(const void* recs, long long n_stride,
                                 const void* starts, const void* ends,
                                 const void* y0, const void* x0,
                                 const void* ia1, const void* ia2,
                                 int n_runs, const void* order,
                                 const void* screens, int nant,
                                 const void* H_planes, const void* grid,
                                 int N, int Nx, int S, float two_pi_s,
                                 float theta_s, float theta_x_s, void* out,
                                 void* stream) {
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
  auto hp = static_cast<const __half*>(H_planes);
  auto g = static_cast<const float2*>(grid);
  auto o = static_cast<float2*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 32:
      return int(launch<32>(r, n_stride, st, en, yy, xx, a1, a2, n_runs, od,
                            sc, nant, hp, g, N, Nx, two_pi_s, theta_s,
                            theta_x_s, o, s));
    case 64:
      return int(launch<64>(r, n_stride, st, en, yy, xx, a1, a2, n_runs, od,
                            sc, nant, hp, g, N, Nx, two_pi_s, theta_s,
                            theta_x_s, o, s));
    case 128:
      return int(launch<128>(r, n_stride, st, en, yy, xx, a1, a2, n_runs, od,
                             sc, nant, hp, g, N, Nx, two_pi_s, theta_s,
                             theta_x_s, o, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* idg_degrid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
